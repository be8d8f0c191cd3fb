"""Fleet-global prefix cache directory: router-resident warmth, pushed
not probed (docs/SERVING.md "Prefix directory").

``prefix_affinity`` routing (r9) GUESSES warmth by fanning a
``lookup_depth`` probe out to every replica's ``PrefixCacheManager`` on
each dispatch — O(replicas) engine reads per request, and a hit rate that
tops out where the warm replica saturates.  The directory inverts the
dataflow: replicas PUBLISH their prefix-chain digests through the cache's
listener bus as pages enter/leave the cache (admission, extension, evict),
and the router answers "who is warm for these tokens" from its own table —
zero per-replica calls on the dispatch hot path.

The digest is :func:`~....inference.v2.ragged.prefix_chain_hashes` — the
SAME chain hash the cache keys pages by, so directory warmth is the
digest-level view of exactly what a subsequent ``match()`` would attach.
The directory stores hashes only (64-bit ints), never tokens or KV: its
footprint is bytes per page per replica, and a stale or colliding entry
can only mis-route, never corrupt (the replica-side ``match()`` verifies
tokens before attaching pages, and the prefix-import path re-checksums
staged bytes).

Staleness ladder (deterministic under ``FleetSimulator``, chaos-tested in
``tests/unit/resilience/test_prefix_chaos.py``):

* evict-after-publish — the directory promises warmth a replica has since
  evicted: the dispatch lands "warm" but ``match()``/``export_prefix``
  find less (or nothing) and the prefill recomputes — slower, never wrong;
* verify-fail — a torn prefix staging is rejected by the snapshot crc at
  import and the target dispatches cold;
* replica death — ``ReplicaPool.kill`` purges every entry the dead
  replica published (``purge``), so the router never routes to (or
  imports from) a ghost;
* directory pressure — the table is BOUNDED (``capacity`` (rid, digest)
  entries, LRU): overflow forgets the coldest entries, which costs at
  most a cold dispatch, exactly like a replica-side cache eviction.

The ``prefix.publish`` chaos site wraps every publish/retract so a drill
can drop directory updates (stale-cold or stale-warm, both rungs of the
ladder) or crash the driver mid-publish.
"""

from collections import OrderedDict
from typing import Dict, Iterable, List, Tuple

from ...inference.v2.ragged import iter_prefix_chain_hashes
from ...resilience import fault_injection as _fi

__all__ = ["PrefixDirectory"]


class PrefixDirectory:
    """Router-resident map ``chain digest -> replicas holding that page``.

    One instance spans the fleet: pass it to ``ReplicaPool(prefix_directory=
    ...)`` (which wires every attached engine's prefix cache to
    :meth:`publish`/:meth:`retract` and purges on death/restart) and to the
    ``prefix_directory`` routing policy (which reads :meth:`depths`).
    """

    def __init__(self, page_size: int, capacity: int = 65536, metrics=None):
        assert page_size >= 1, page_size
        assert capacity >= 1, capacity
        self.page_size = int(page_size)
        self.capacity = int(capacity)
        # telemetry: always-on counters on the fleet MetricsRegistry when
        # one is attached (the same registry the replica frontends share)
        self.metrics = metrics
        #: digest -> set of rids that published it
        self._holders: Dict[int, set] = {}
        #: (rid, digest) -> None, oldest first — the LRU the capacity
        #: bound evicts from; refreshed on re-publish and on lookup match
        self._lru: "OrderedDict[Tuple[int, int], None]" = OrderedDict()
        #: host-tier mirror (serving/kvtier): digest -> rids whose HOST
        #: tier holds the page.  Host-warm is a second-class warmth — the
        #: target can promote the page h2d instead of recomputing — so it
        #: is tracked in its own table (same capacity bound, own LRU) and
        #: reported separately by :meth:`tiered_depths`.
        self._host_holders: Dict[int, set] = {}
        self._host_lru: "OrderedDict[Tuple[int, int], None]" = OrderedDict()
        self.stats = {"published": 0, "retracted": 0, "purged": 0,
                      "lru_evicted": 0, "lookups": 0,
                      "host_published": 0, "host_retracted": 0}

    # ------------------------------------------------------------- publish

    def publish(self, rid: int, digest: int) -> None:
        """A replica's cache registered a full page keyed by ``digest``.
        Idempotent per (rid, digest); a re-publish refreshes the LRU."""
        _fi.check("prefix.publish")   # chaos site: dropped/crashed publish
        key = (rid, digest)
        if key in self._lru:
            self._lru.move_to_end(key)
            return
        self._holders.setdefault(digest, set()).add(rid)
        self._lru[key] = None
        self.stats["published"] += 1
        if self.metrics is not None:
            self.metrics.counter("prefix/publish").inc()
        while len(self._lru) > self.capacity:
            (orid, odig), _ = self._lru.popitem(last=False)
            self._drop(orid, odig)
            self.stats["lru_evicted"] += 1

    def retract(self, rid: int, digest: int) -> None:
        """A replica's cache evicted the page keyed by ``digest``."""
        _fi.check("prefix.publish")   # same stream as publish: one site
        key = (rid, digest)
        if key not in self._lru:
            return
        del self._lru[key]
        self._drop(rid, digest)
        self.stats["retracted"] += 1
        if self.metrics is not None:
            self.metrics.counter("prefix/evict").inc()

    def publish_host(self, rid: int, digest: int) -> None:
        """``rid``'s HOST tier (serving/kvtier) staged the page keyed by
        ``digest``: a demotion parked it CPU-side, still promotable.
        Same chaos stream as device publishes — a dropped host publish is
        the stale-cold rung (the fleet forgets warmth it has)."""
        _fi.check("prefix.publish")
        key = (rid, digest)
        if key in self._host_lru:
            self._host_lru.move_to_end(key)
            return
        self._host_holders.setdefault(digest, set()).add(rid)
        self._host_lru[key] = None
        self.stats["host_published"] += 1
        if self.metrics is not None:
            self.metrics.counter("prefix/publish").inc()
        while len(self._host_lru) > self.capacity:
            (orid, odig), _ = self._host_lru.popitem(last=False)
            self._drop_host(orid, odig)
            self.stats["lru_evicted"] += 1

    def retract_host(self, rid: int, digest: int) -> None:
        """``rid``'s host tier dropped the page (promoted back to the
        device — now a device publish — or evicted under host pressure)."""
        _fi.check("prefix.publish")
        key = (rid, digest)
        if key not in self._host_lru:
            return
        del self._host_lru[key]
        self._drop_host(rid, digest)
        self.stats["host_retracted"] += 1
        if self.metrics is not None:
            self.metrics.counter("prefix/evict").inc()

    def purge(self, rid: int) -> int:
        """Forget every entry ``rid`` published — replica death (the
        engine, its cache AND its host tier are gone) or a fresh engine
        attach (restart: the new cache starts empty).  Returns entries
        dropped (both tiers)."""
        victims = [key for key in self._lru if key[0] == rid]
        for key in victims:
            del self._lru[key]
            self._drop(*key)
        host_victims = [key for key in self._host_lru if key[0] == rid]
        for key in host_victims:
            del self._host_lru[key]
            self._drop_host(*key)
        self.stats["purged"] += len(victims) + len(host_victims)
        return len(victims) + len(host_victims)

    def _drop(self, rid: int, digest: int) -> None:
        holders = self._holders.get(digest)
        if holders is not None:
            holders.discard(rid)
            if not holders:
                del self._holders[digest]

    def _drop_host(self, rid: int, digest: int) -> None:
        holders = self._host_holders.get(digest)
        if holders is not None:
            holders.discard(rid)
            if not holders:
                del self._host_holders[digest]

    # -------------------------------------------------------------- lookup

    def depths(self, tokens: Iterable[int],
               rids: Iterable[int]) -> Dict[int, int]:
        """Per-replica warmth for ``tokens``: how many LEADING full pages
        of the token history each rid (per the directory) holds — the same
        quantity ``PrefixCacheManager.lookup_depth`` reports, including
        its last-token cap (the engine must still compute >= 1 token), so
        directory routing and the probe policy agree whenever the
        directory is fresh (the regression oracle in
        tests/unit/inference/test_prefix_directory.py).  One chain walk
        total — NO per-replica engine calls.  Matched entries' LRU is
        refreshed: routed-on prefixes are hot prefixes."""
        tokens = list(tokens)
        rids = list(rids)
        depth = {rid: 0 for rid in rids}
        self.stats["lookups"] += 1
        usable_pages = max(0, (len(tokens) - 1) // self.page_size)
        live = set(rids)
        for k, digest in enumerate(iter_prefix_chain_hashes(
                tokens[:usable_pages * self.page_size], self.page_size)):
            holders = self._holders.get(digest)
            if holders is None:
                break
            live &= holders
            if not live:
                break
            for rid in sorted(live):
                depth[rid] = k + 1
                self._lru.move_to_end((rid, digest))
        return depth

    def tiered_depths(self, tokens: Iterable[int],
                      rids: Iterable[int]) -> Dict[int, Tuple[int, int]]:
        """Per-replica ``(device_depth, warm_depth)`` for ``tokens``.

        ``device_depth`` is exactly what :meth:`depths` reports: leading
        full pages resident in the replica's DEVICE cache (attach is
        free).  ``warm_depth >= device_depth`` extends the chain through
        pages the replica holds in EITHER tier — a host-tier page costs a
        bounded h2d promote instead of a prefill recompute, so a
        host-warm replica beats a cold one but loses to a device-warm
        one at equal depth.  One chain walk total, same last-token cap."""
        tokens = list(tokens)
        rids = list(rids)
        out = {rid: (0, 0) for rid in rids}
        self.stats["lookups"] += 1
        usable_pages = max(0, (len(tokens) - 1) // self.page_size)
        live_dev = set(rids)
        live_warm = set(rids)
        for k, digest in enumerate(iter_prefix_chain_hashes(
                tokens[:usable_pages * self.page_size], self.page_size)):
            dev = self._holders.get(digest, ())
            host = self._host_holders.get(digest, ())
            live_dev &= set(dev)
            live_warm &= set(dev) | set(host)
            if not live_warm:
                break
            for rid in sorted(live_warm):
                d, _ = out[rid]
                if rid in live_dev:
                    d = k + 1
                    self._lru.move_to_end((rid, digest))
                elif (rid, digest) in self._host_lru:
                    self._host_lru.move_to_end((rid, digest))
                out[rid] = (d, k + 1)
        return out

    def hottest(self, k: int) -> List[Tuple[int, List[int]]]:
        """The ``k`` most-recently-used digests (newest LRU end first),
        each with the sorted rids holding it — the directory-driven
        autoscale warm-up input: a RECOVERING replica pre-imports these
        chains' KV from a live donor so it joins the fleet warm instead of
        eating a cold-start recompute on its first dispatches.  Digests
        are deduplicated across replicas (one import warms the chain
        fleet-wide for the target)."""
        out: List[Tuple[int, List[int]]] = []
        seen = set()
        for rid, digest in reversed(self._lru):
            if digest in seen:
                continue
            seen.add(digest)
            out.append((digest, sorted(self._holders.get(digest, ()))))
            if len(out) >= k:
                break
        return out

    # ------------------------------------------------------------- surface

    @property
    def entries(self) -> int:
        return len(self._lru)

    @property
    def host_entries(self) -> int:
        return len(self._host_lru)

    def summary(self) -> dict:
        return {**self.stats, "entries": self.entries,
                "host_entries": self.host_entries,
                "digests": len(self._holders), "capacity": self.capacity}
