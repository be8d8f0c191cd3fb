"""Pluggable fleet routing policies.

A policy answers one question per request: which dispatchable replica gets
it.  Input is the candidate list the router assembled — ``(rid, replica,
stats)`` with ``stats = ServingEngine.load_stats()`` — so policies are pure
decisions over cheap snapshots and never touch engine internals except the
read-only prefix-cache warmth probe.

* :class:`RoundRobinPolicy` — rotate over dispatchable replicas; the
  baseline every serving stack ships.
* :class:`LeastOutstandingPolicy` — fewest outstanding decode tokens (the
  actual forward-pass work still owed), queue depth as tie-break: the
  classic least-loaded estimator for continuous batching, where "requests
  in flight" under-weights long generations.
* :class:`PrefixAffinityPolicy` — route to the replica whose
  ``PrefixCacheManager`` already holds the longest page run of the
  request's token history (probed via the non-mutating
  ``lookup_depth``), so shared-prefix traffic (system prompts, few-shot
  templates, failover resumes) reuses KV instead of recomputing it on a
  cold replica.  When the warmest replica is saturated — queue at or past
  ``saturation_queue_depth`` — the policy falls back to least-loaded:
  cache locality is a latency optimization, never a reason to queue behind
  a hot spot (the standard prefix-aware routing compromise).
* :class:`DisaggregatedPolicy` — role-aware placement for a
  prefill/decode-split fleet: fresh prompts land on PREFILL-role
  replicas, resumed/migrated requests on DECODE-role ones, least-loaded
  within the pool (DistServe/Splitwise-style phase splitting; the KV
  handoff between the pools is the router's migration machinery).
* :class:`PrefixDirectoryPolicy` — prefix affinity answered from the
  router-resident :class:`~.prefix_directory.PrefixDirectory` instead of
  probe fan-out: ZERO per-replica calls per dispatch.  When the warm
  target is saturated the request goes least-loaded — and the policy asks
  the router to IMPORT the hot prefix's KV pages onto that cold replica
  first (``prefix_import`` in the select info), turning warm-replica
  affinity into cluster-wide warmth (docs/SERVING.md "Prefix directory").
* :class:`SessionAffinityPolicy` — sticky-with-failover placement for
  agentic sessions (serving/sessions): every turn of a session lands on
  the replica that served the previous one — its prefix cache already
  holds the FULL transcript's pages, so turn N+1 prefills only the new
  user tokens.  When the sticky replica is dead or saturated the turn
  re-homes through the wrapped fallback (directory-warmth when a
  directory is attached, least-loaded otherwise) and the session
  re-sticks there (docs/SERVING.md "Agentic sessions").
"""

from typing import List, Optional, Tuple

from ..request import ServingRequest  # noqa: F401  (doc reference)


class RoutingPolicy:
    """Base: ``select`` returns ``(rid, info)``; rid None = nothing
    eligible (request stays pending).  ``info`` is a small dict of
    policy-specific facts the router folds into its stats (e.g.
    ``affinity_hit``)."""

    name = "base"

    def select(self, request, candidates: List[Tuple[int, object, dict]]):
        raise NotImplementedError


class RoundRobinPolicy(RoutingPolicy):

    name = "round_robin"

    def __init__(self):
        self._turn = 0

    def select(self, request, candidates):
        if not candidates:
            return None, {}
        rids = sorted(rid for rid, _, _ in candidates)
        rid = rids[self._turn % len(rids)]
        self._turn += 1
        return rid, {}


class LeastOutstandingPolicy(RoutingPolicy):

    name = "least_outstanding"

    def select(self, request, candidates):
        if not candidates:
            return None, {}
        rid = min(candidates,
                  key=lambda c: (c[2]["outstanding_tokens"], c[2]["queue_depth"], c[0]))[0]
        return rid, {}


class PrefixAffinityPolicy(RoutingPolicy):

    name = "prefix_affinity"

    def __init__(self, saturation_queue_depth: int = 4):
        assert saturation_queue_depth >= 1, saturation_queue_depth
        self.saturation_queue_depth = saturation_queue_depth
        self._fallback = LeastOutstandingPolicy()

    def _warmth(self, replica, tokens) -> int:
        pc = replica.serve.engine.kv.prefix_cache if replica.serve is not None else None
        if pc is None or not tokens:
            return 0
        return pc.lookup_depth(tokens)

    def select(self, request, candidates):
        if not candidates:
            return None, {}
        # probe with the full token history (prompt + already-generated):
        # a failover resume is exactly the traffic whose warm pages matter
        tokens = list(request.prompt) + list(request.tokens)
        warmth = {rid: self._warmth(rep, tokens) for rid, rep, _ in candidates}
        best = max(candidates, key=lambda c: (warmth[c[0]], -c[2]["queue_depth"], -c[0]))
        rid, _, stats = best
        if warmth[rid] > 0 and stats["queue_depth"] < self.saturation_queue_depth:
            return rid, {"affinity_hit": True, "warm_pages": warmth[rid]}
        # cold everywhere, or the warm target is saturated: least-loaded —
        # EXCLUDING the saturated warm target when an alternative exists
        # (falling back onto the hot spot it just rejected would defeat the
        # fallback; with no alternative it is still the only choice)
        saturated = warmth[rid] > 0
        fb_candidates = [c for c in candidates if c[0] != rid] if saturated else candidates
        if not fb_candidates:
            fb_candidates = candidates
        fb_rid, _ = self._fallback.select(request, fb_candidates)
        # the hit label reports where the request actually LANDED: a
        # fallback that still reaches a warm cache (e.g. the sole replica)
        # gets the prefill speedup all the same
        return fb_rid, {"affinity_hit": warmth.get(fb_rid, 0) > 0,
                        "warm_pages": warmth.get(fb_rid, 0),
                        "affinity_saturated": saturated}


class DisaggregatedPolicy(RoutingPolicy):
    """Role-aware placement for a prefill/decode-disaggregated fleet
    (docs/SERVING.md "Disaggregated serving").

    A FRESH request (no tokens yet) is prompt-processing work → place it
    on a PREFILL-role replica; a RESUMED request (failover victim or a
    migration handoff carrying generated tokens) is token-generation work
    → place it on a DECODE-role replica.  MIXED replicas qualify for
    either.  Within the matching pool the least-outstanding estimator
    breaks ties; when NO replica of the wanted role is dispatchable the
    policy falls back to the full candidate list — every replica runs the
    complete stack, and availability beats specialization (a decode-only
    fleet rump must still serve fresh prompts rather than starve them).

    The KV handoff itself (export → least-loaded decode replica → import)
    is the router's migration machinery; this policy only answers where
    NEW dispatches land."""

    name = "disaggregated"
    #: turns on the Router's two-phase dispatch: requests reaching DECODE
    #: on a PREFILL-role replica are exported + resumed on a decode replica
    migrates = True

    def __init__(self):
        self._fallback = LeastOutstandingPolicy()

    def select(self, request, candidates):
        from .pool import ReplicaRole
        if not candidates:
            return None, {}
        # token-generation work: the request already generated tokens OR
        # carries a host-staged KV snapshot (a late-prefill handoff or a
        # failover-reuse victim with no tokens yet) — routing it back to
        # the prefill pool would import there and immediately re-migrate
        decode_work = bool(getattr(request, "tokens", None)) \
            or getattr(request, "_kv_snapshot", None) is not None
        want = ReplicaRole.DECODE if decode_work else ReplicaRole.PREFILL
        matched = [c for c in candidates
                   if c[1].role in (want, ReplicaRole.MIXED)]
        rid, info = self._fallback.select(request, matched or candidates)
        return rid, {**info, "phase": want.value, "role_match": bool(matched)}


class PrefixDirectoryPolicy(RoutingPolicy):
    """Directory-resident prefix affinity with cold-replica KV import
    (docs/SERVING.md "Prefix directory").

    Same placement shape as :class:`PrefixAffinityPolicy` — warmest
    replica unless its queue is saturated, least-loaded otherwise — but
    warmth comes from ONE :class:`~.prefix_directory.PrefixDirectory`
    walk over the request's token digests: no ``lookup_depth`` probe
    fan-out, no engine reads, O(prefix pages) per dispatch however many
    replicas the fleet runs.  The probe policy stays available as the
    directory-less fallback and as the cross-check oracle in tests.

    The ambitious half: when the fleet IS warm for this prefix but the
    chosen (least-loaded) replica is cold — the saturated-hot-spot case
    where the probe policy eats a full recompute — the select info carries
    a ``prefix_import`` plan naming the warmest donor; the router exports
    those immutable full pages once to host and adopts them into the cold
    replica's prefix cache BEFORE the dispatch, so the request lands warm
    anyway.  ``import_min_pages`` gates the plan on the warmth deficit
    being worth a staging round-trip."""

    name = "prefix_directory"

    def __init__(self, directory, saturation_queue_depth: int = 4,
                 import_min_pages: int = 1):
        assert saturation_queue_depth >= 1, saturation_queue_depth
        assert import_min_pages >= 1, import_min_pages
        self.directory = directory
        self.saturation_queue_depth = saturation_queue_depth
        self.import_min_pages = import_min_pages
        self._fallback = LeastOutstandingPolicy()

    def select(self, request, candidates):
        if not candidates:
            return None, {}
        # full token history (prompt + already-generated): a failover
        # resume is exactly the traffic whose warm pages matter — same
        # stance as the probe policy
        tokens = list(request.prompt) + list(request.tokens)
        # two-tier warmth (serving/kvtier): device-resident pages attach
        # for free; host-staged pages cost a bounded h2d promote — better
        # than cold, worse than device-warm.  With no host tier attached
        # warm == device and this orders exactly like the old single-tier
        # key (the probe-policy oracle still holds).
        tiered = self.directory.tiered_depths(
            tokens, [rid for rid, _, _ in candidates])
        best = max(candidates, key=lambda c: (
            tiered[c[0]][0], tiered[c[0]][1], -c[2]["queue_depth"], -c[0]))
        rid, _, stats = best
        dev, warm = tiered[rid]
        if warm > 0 and stats["queue_depth"] < self.saturation_queue_depth:
            info = {"affinity_hit": True, "warm_pages": dev}
            if warm > dev:
                info["host_warm"] = True
                info["host_pages"] = warm - dev
            return rid, info
        # cold everywhere, or the warm target is saturated: least-loaded,
        # excluding the saturated warm target when an alternative exists
        # (identical fallback shape to PrefixAffinityPolicy)
        saturated = warm > 0
        fb_candidates = [c for c in candidates if c[0] != rid] if saturated else candidates
        if not fb_candidates:
            fb_candidates = candidates
        fb_rid, _ = self._fallback.select(request, fb_candidates)
        fb_dev, fb_warm = tiered.get(fb_rid, (0, 0))
        info = {"affinity_hit": fb_warm > 0,
                "warm_pages": fb_dev,
                "affinity_saturated": saturated}
        if fb_warm > fb_dev:
            info["host_warm"] = True
            info["host_pages"] = fb_warm - fb_dev
        if saturated and fb_rid is not None \
                and warm - fb_warm >= self.import_min_pages:
            # the fleet is warm, the landing replica is not: ask the router
            # to import the hot prefix there before dispatch (the router
            # flips affinity_hit to True if the import lands).  The donor
            # depth counts BOTH tiers — export_prefix sources the host-
            # staged tail from the donor's kvtier without touching its
            # device arena.
            info["prefix_import"] = {"donor": rid, "donor_depth": warm}
        return fb_rid, info


class SessionAffinityPolicy(RoutingPolicy):
    """Sticky-with-failover session placement (docs/SERVING.md "Agentic
    sessions").

    The map is ``session_id -> rid``, learned from wherever each session's
    LAST dispatch landed.  The sticky replica wins whenever it is a live
    candidate below ``saturation_queue_depth`` — its prefix cache holds
    the session's whole transcript (generated tokens included: the engine
    publishes full pages as decode progresses), so the sticky turn
    prefills only the fresh user suffix.  Otherwise the turn re-homes:

    * sticky replica DEAD (not in candidates) or SATURATED → fall back to
      the wrapped policy — :class:`PrefixDirectoryPolicy` when a
      directory is attached (a failover turn carries the transcript
      prefix, and the directory may know a second-warm replica or plan a
      ``prefix_import`` onto the landing one), least-loaded otherwise —
      and RE-STICK to wherever the turn lands.
    * session-less requests (``session_id`` is None) go straight to the
      fallback: mixing stateless traffic through the sticky map would
      pin it to arbitrary replicas.

    Info keys: ``session_sticky`` (the sticky fast path won),
    ``session_failover`` (a previously-stuck session re-homed), plus
    whatever the fallback contributes (``affinity_hit``,
    ``prefix_import`` ...)."""

    name = "session_affinity"

    def __init__(self, directory=None, saturation_queue_depth: int = 4,
                 import_min_pages: int = 1):
        assert saturation_queue_depth >= 1, saturation_queue_depth
        self.saturation_queue_depth = saturation_queue_depth
        self._sticky = {}          # session_id -> rid of the last dispatch
        self._fallback = PrefixDirectoryPolicy(
            directory, saturation_queue_depth=saturation_queue_depth,
            import_min_pages=import_min_pages) if directory is not None \
            else LeastOutstandingPolicy()

    def select(self, request, candidates):
        if not candidates:
            return None, {}
        sid = getattr(request, "session_id", None)
        if sid is None:
            return self._fallback.select(request, candidates)
        rid = self._sticky.get(sid)
        if rid is not None:
            for c_rid, _, stats in candidates:
                if c_rid == rid and \
                        stats["queue_depth"] < self.saturation_queue_depth:
                    return rid, {"session_sticky": True}
        fb_rid, info = self._fallback.select(request, candidates)
        if fb_rid is None:
            return None, {}
        info = {**info, "session_sticky": False}
        if rid is not None and fb_rid != rid:
            info["session_failover"] = True
        self._sticky[sid] = fb_rid
        return fb_rid, info


POLICIES = {p.name: p for p in (RoundRobinPolicy, LeastOutstandingPolicy,
                                PrefixAffinityPolicy, DisaggregatedPolicy,
                                PrefixDirectoryPolicy, SessionAffinityPolicy)}


def make_policy(name: str, **kwargs) -> RoutingPolicy:
    if name not in POLICIES:
        raise ValueError(f"unknown routing policy '{name}'; one of {sorted(POLICIES)}")
    return POLICIES[name](**kwargs)
