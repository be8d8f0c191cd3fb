"""Simulated control-plane fabric: typed, versioned, sequence-numbered
messages between the fleet router and its replicas, with injectable loss,
duplication, reordering, bounded delay and named partition windows — all
driven by the shared ``VirtualClock`` so every delivery schedule is
bit-reproducible (docs/SERVING.md "Control-plane transport").

Until r16 every fleet control flow — health observation, ``load_stats()``
routing signals, prefix-directory publishes, migration chunk pumps,
autoscaler inputs — was a perfect, instantaneous in-process call.  A real
multi-host fleet gets none of that: its control plane is datagrams that
drop, duplicate, arrive late or out of order, and sometimes cannot cross
a network partition at all.  This module is the deterministic stand-in
for that fabric, and the rest of ``serving/fleet`` re-homes its control
flows onto it:

* **heartbeats + leases** — replicas heartbeat their health state and
  ``load_stats()`` each round; the router's
  :class:`~.health.FleetHealthView` turns silence into SUSPECT (no new
  dispatches) and an expired lease into a fleet-declared death
  (``Router.on_lease_expired``: displaced work is re-dispatched, the
  replica's dispatch epoch is bumped, and a surviving "zombie" replica is
  FENCED on its first post-partition heartbeat — its late completions are
  discarded, so no request is ever served twice);
* **sequence-numbered state sync** — prefix-directory publishes carry a
  per-replica ``(rid, seqno)``; a gap triggers ``prefix/publish_gap`` and
  a targeted full-digest resync instead of silent absorption;
* **ack/retry chunk delivery** — migration chunks flow stop-and-wait with
  cumulative acks and idempotent (index-checked) import, so loss costs
  retransmits, never torn snapshots;
* **lifecycle commands** (r21) — autoscaler recover/drain/park/
  role-change and migration completion ride typed, seq-numbered,
  epoch-fenced ``lifecycle_cmd`` messages with the same stop-and-wait
  ack/retry discipline as migration chunks; the replica side dedups by
  command seq and rejects commands stamped with a pre-fencing epoch, so
  a partitioned or zombie replica can never act on — or double-apply —
  a stale command (``Router._apply_lifecycle``).

Message taxonomy (``kind``):

=================  =========================  ==============================
kind               direction                  payload
=================  =========================  ==============================
``heartbeat``      replica -> router          local health state, load_stats
``dir_publish``    replica -> router          prefix digest publish/retract
``dir_resync_req`` router -> replica          request a full-digest snapshot
``dir_resync``     replica -> router          digests + publish-seq barrier
``fence``          router -> replica          dispatch epoch to fence
``fence_ack``      replica -> router          epoch echo + cancel counts
``mig_chunk``      source replica -> router   KV chunk (idx, crc, last flag)
``mig_ack``        router -> source replica   cumulative chunk ack
``lifecycle_cmd``  router -> replica          op + cmd seq + dispatch epoch
``lifecycle_ack``  replica -> router          cmd seq + epoch echo + status
=================  =========================  ==============================

Faults are drawn per message in SEND order from one seeded
``random.Random``, so the same workload + fault config + partition
schedule replays the same delivery sequence byte-for-byte on every run
and machine.  The ``transport.send`` / ``transport.deliver`` injection
sites (docs/RESILIENCE.md) additionally let the chaos harness drop
specific messages (``os_error``) or kill the driver mid-flight
(``crash``) at deterministic hit counts.

Correctness stance, as everywhere in this repo: the transport may make
the fleet SLOWER (stale routing, retransmits, lease waits) but never
WRONG — final outputs stay byte-identical to the unperturbed golden run
under every schedule, which is exactly what
``tests/unit/resilience/test_transport_chaos.py`` pins.
"""

import dataclasses
import random
from typing import Dict, Iterable, List, Optional, Tuple, Union

from ...resilience import fault_injection as _fi

#: wire-format version stamped on every message; a receiver that sees a
#: different major version must resync, not guess (single-version today)
MESSAGE_VERSION = 1

#: the closed message-kind vocabulary; ``send`` rejects unknown kinds so a
#: typo'd control flow fails loudly instead of silently never delivering
MESSAGE_KINDS = frozenset({
    "heartbeat", "dir_publish", "dir_resync_req", "dir_resync",
    "fence", "fence_ack", "mig_chunk", "mig_ack",
    "lifecycle_cmd", "lifecycle_ack",
})

#: the control-plane endpoint name of the router; replicas are their rids
ROUTER = "router"

Endpoint = Union[str, int]


@dataclasses.dataclass(frozen=True)
class Message:
    """One typed, versioned, sequence-numbered control-plane datagram."""
    kind: str
    src: Endpoint
    dst: Endpoint
    seq: int                 # per-(src, kind-stream) sequence number
    send_ts: float
    payload: dict
    version: int = MESSAGE_VERSION
    #: transport-global monotonic message id — the CAUSAL link between a
    #: send and its delivery(ies) in the flight recorder: the ``ctrl/*``
    #: span a delivery materializes carries this id, and a duplicated
    #: message's two deliveries share it (dup visible per link)
    mid: int = 0


@dataclasses.dataclass(frozen=True)
class LinkFaults:
    """Per-link fault model.  All probabilities are drawn per message in
    send order from the transport's one seeded RNG."""
    loss_p: float = 0.0        # message silently dropped
    dup_p: float = 0.0         # a second copy is delivered late
    reorder_p: float = 0.0     # message delayed past its successors
    delay: float = 0.0         # base one-way delivery delay (seconds)
    reorder_delay: float = 1.0  # extra delay for reordered/duplicated copies

    def __post_init__(self):
        for name in ("loss_p", "dup_p", "reorder_p"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}={p} not a probability")
        if self.delay < 0 or self.reorder_delay < 0:
            raise ValueError(f"negative delay ({self.delay}, {self.reorder_delay})")


@dataclasses.dataclass(frozen=True)
class PartitionWindow:
    """A NAMED partition: the listed endpoint pairs cannot exchange
    messages (either direction) while ``t0 <= ts < t1``.  Severance is
    checked at BOTH ends of a message's flight — at send time and again
    at delivery time — so a partition also eats datagrams already in the
    air when it starts (the pessimistic model; a fabric that queued them
    would only be kinder)."""
    name: str
    t0: float
    t1: float
    pairs: Tuple[Tuple[Endpoint, Endpoint], ...]

    def __post_init__(self):
        if not self.t1 > self.t0:
            raise ValueError(f"partition '{self.name}' window empty "
                             f"({self.t0}, {self.t1})")
        object.__setattr__(self, "pairs",
                           tuple((a, b) for a, b in self.pairs))

    def severs(self, a: Endpoint, b: Endpoint, ts: float) -> bool:
        if not self.t0 <= ts < self.t1:
            return False
        return any({a, b} == {x, y} for x, y in self.pairs)


class ControlTransport:
    """The deterministic fabric every fleet control message crosses.

    ``send`` schedules delivery (or drops, duplicates, delays per the
    seeded fault model and partition schedule); ``deliver(now)`` returns
    every message whose delivery time has come, in deterministic
    ``(deliver_ts, enqueue order)`` order.  With the default
    ``LinkFaults()`` and no partitions the transport is PERFECT (zero
    delay, zero loss): behavior is observationally identical to the
    pre-transport in-process fleet, one poll-round of latency aside.
    """

    def __init__(self, clock, faults: LinkFaults = None, seed: int = 0,
                 partitions: Iterable[PartitionWindow] = (),
                 link_faults: Optional[Dict[frozenset, LinkFaults]] = None,
                 metrics=None, recorder=None):
        self.clock = clock
        self.faults = faults or LinkFaults()
        #: per-link overrides keyed by ``frozenset({a, b})``
        self.link_faults = dict(link_faults or {})
        self.partitions: List[PartitionWindow] = list(partitions)
        self.metrics = metrics
        #: optional flight recorder (telemetry/flight_recorder.py): every
        #: DELIVERED message becomes a ``ctrl/<kind>`` span [send_ts,
        #: deliver_ts] on its link's track (the send→deliver causal pair,
        #: dup deliveries sharing the message's ``mid``), every message
        #: the fabric ate a ``ctrl/drop`` instant with its cause — the
        #: per-link drop/dup/retransmit visibility the recorder exists for
        self.recorder = recorder
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._eid = 0                        # total enqueue order (determinism)
        self._mid = 0                        # causal message ids (recorder)
        #: in-flight: (deliver_ts, eid, Message) — sorted at deliver time
        self._in_flight: List[Tuple[float, int, Message]] = []
        self.stats = {
            "sent": 0, "delivered": 0, "dropped": 0, "partition_dropped": 0,
            "duplicated": 0, "reordered": 0, "delayed": 0, "send_faults": 0,
            "deliver_faults": 0, "retransmits": 0,
        }
        #: per-link health accounting for the adaptive-lease-sizing signal
        #: (ROADMAP): ``loss_ewma`` folds every message's RESOLVED fate
        #: (1 = eaten — at send by loss/fault/partition, or at deliver by
        #: a deliver fault / a partition that opened mid-flight; 0 =
        #: delivered) with alpha 0.2 — keyed by frozenset({a, b})
        self._link_health: Dict[frozenset, dict] = {}

    # ------------------------------------------------------------- topology

    def add_partition(self, window: PartitionWindow) -> None:
        self.partitions.append(window)

    def connected(self, a: Endpoint, b: Endpoint, ts: float) -> bool:
        """Is the (a, b) link traversable at ``ts`` (partition schedule
        only — random loss is per-message, not a link state)?"""
        return not any(p.severs(a, b, ts) for p in self.partitions)

    def active_partitions(self, ts: float) -> List[str]:
        return [p.name for p in self.partitions if p.t0 <= ts < p.t1]

    def _link(self, a: Endpoint, b: Endpoint) -> LinkFaults:
        return self.link_faults.get(frozenset((a, b)), self.faults)

    # ----------------------------------------------------------------- send

    def _count(self, name: str) -> None:
        self.stats[name] += 1
        if self.metrics is not None:
            self.metrics.counter(f"transport/{name}").inc()

    def note_retransmit(self) -> None:
        """A reliable stream (fence retry, chunk stop-and-wait, resync
        re-request) re-sent a message the receiver never acked."""
        self._count("retransmits")

    def _track(self, src: Endpoint, dst: Endpoint) -> str:
        return f"ctrl/link/{src}-{dst}"

    def _note_link(self, src: Endpoint, dst: Endpoint, eaten: bool) -> None:
        """Fold one RESOLVED message fate into the link's health.  Called
        exactly once per message at the point its fate is known — a
        send-time drop, a deliver-time drop, or a delivery (a duplicated
        message's extra copy resolves separately: the link genuinely
        carried both) — so a link whose sends depart fine but whose
        deliveries all die still reads as lossy."""
        h = self._link_health.get(frozenset((src, dst)))
        if h is None:
            h = self._link_health[frozenset((src, dst))] = {
                "resolved": 0, "eaten": 0, "loss_ewma": 0.0}
        h["resolved"] += 1
        if eaten:
            h["eaten"] += 1
        h["loss_ewma"] = 0.8 * h["loss_ewma"] + 0.2 * (1.0 if eaten else 0.0)

    def link_loss_ewma(self, a: Endpoint, b: Endpoint) -> float:
        """Observed loss EWMA of the (a, b) link — random loss, injected
        send/deliver faults and partition severance (at send OR opening
        mid-flight) folded together (what matters to a lease is whether
        messages GET THROUGH, not why they don't).  0.0 before any
        resolved traffic; messages still in flight have no fate yet.  The
        per-round ``transport/link_loss_ewma/<rid>`` gauge — ROADMAP's
        adaptive-lease-sizing input signal — reads this."""
        h = self._link_health.get(frozenset((a, b)))
        return 0.0 if h is None else h["loss_ewma"]

    def link_health(self) -> Dict[str, dict]:
        """Deterministically-keyed per-link health table (summary surface)."""
        out = {}
        for key in sorted(self._link_health, key=lambda k: sorted(map(str, k))):
            a, b = sorted(map(str, key))
            h = self._link_health[key]
            out[f"{a}-{b}"] = {"resolved": h["resolved"], "eaten": h["eaten"],
                               "loss_ewma": round(h["loss_ewma"], 9)}
        return out

    def send(self, kind: str, src: Endpoint, dst: Endpoint, payload: dict,
             seq: int = 0) -> Optional[Message]:
        """Schedule one message.  Returns the Message when it was put in
        flight, None when the fabric ate it (loss, partition, injected
        send fault) — senders that need delivery retry on a timer; the
        fire-and-forget streams (heartbeats, publishes) rely on leases
        and seq-gap resync instead."""
        if kind not in MESSAGE_KINDS:
            raise ValueError(f"unknown message kind '{kind}'; one of "
                             f"{sorted(MESSAGE_KINDS)}")
        now = self.clock.now()
        self._count("sent")
        self._mid += 1
        mid = self._mid
        try:
            # chaos site: the send edge of every control message
            _fi.check("transport.send")
        except _fi.InjectedCrash:
            raise  # simulated death of THIS driver process
        except OSError:
            # injected send fault: the datagram never left the host
            self._count("send_faults")
            self._count("dropped")
            self._note_link(src, dst, eaten=True)
            self._record_drop(kind, src, dst, seq, mid, now, "send_fault")
            return None
        msg = Message(kind=kind, src=src, dst=dst, seq=int(seq),
                      send_ts=now, payload=payload, mid=mid)
        if not self.connected(src, dst, now):
            self._count("partition_dropped")
            self._note_link(src, dst, eaten=True)
            self._record_drop(kind, src, dst, seq, mid, now, "partition")
            return None
        link = self._link(src, dst)
        # ONE rng, consumed in send order: loss, reorder, dup — always all
        # three draws, so a fired fault never shifts its successors' draws
        lost = self._rng.random() < link.loss_p
        reordered = self._rng.random() < link.reorder_p
        duped = self._rng.random() < link.dup_p
        if lost:
            self._count("dropped")
            self._note_link(src, dst, eaten=True)
            self._record_drop(kind, src, dst, seq, mid, now, "loss")
            return None
        delay = link.delay
        if reordered:
            delay += link.reorder_delay
            self._count("reordered")
        if delay > 0:
            self._count("delayed")
        self._eid += 1
        self._in_flight.append((now + delay, self._eid, msg))
        if duped:
            self._count("duplicated")
            self._eid += 1
            self._in_flight.append((now + delay + link.reorder_delay,
                                    self._eid, msg))
        return msg

    # -------------------------------------------------------------- deliver

    def deliver(self, now: Optional[float] = None) -> List[Message]:
        """Pop every message due by ``now`` in (deliver_ts, enqueue) order.
        A message whose link is severed at its DELIVERY instant is eaten
        by the partition (it was in the air when the cut landed)."""
        now = self.clock.now() if now is None else now
        due = [e for e in self._in_flight if e[0] <= now]
        if not due:
            return []
        due.sort(key=lambda e: (e[0], e[1]))
        self._in_flight = [e for e in self._in_flight if e[0] > now]
        out: List[Message] = []
        for deliver_ts, _eid, msg in due:
            try:
                # chaos site: the delivery edge (receiver-side I/O)
                _fi.check("transport.deliver")
            except _fi.InjectedCrash:
                raise  # simulated death of THIS driver process
            except OSError:
                self._count("deliver_faults")
                self._count("dropped")
                self._note_link(msg.src, msg.dst, eaten=True)
                self._record_drop(msg.kind, msg.src, msg.dst, msg.seq,
                                  msg.mid, deliver_ts, "deliver_fault")
                continue
            if not self.connected(msg.src, msg.dst, deliver_ts):
                self._count("partition_dropped")
                self._note_link(msg.src, msg.dst, eaten=True)
                self._record_drop(msg.kind, msg.src, msg.dst, msg.seq,
                                  msg.mid, deliver_ts, "partition")
                continue
            self._count("delivered")
            self._note_link(msg.src, msg.dst, eaten=False)
            if self.recorder is not None:
                # the causal send→deliver pair: one span per delivery,
                # [send_ts, deliver_ts] on the link's track; duplicated
                # copies share the mid (dups visible), retransmits show as
                # distinct mids of the same (kind, seq)
                self.recorder.span(f"ctrl/{msg.kind}",
                                   self._track(msg.src, msg.dst),
                                   msg.send_ts, deliver_ts,
                                   attrs={"src": str(msg.src),
                                          "dst": str(msg.dst),
                                          "seq": msg.seq, "mid": msg.mid})
            out.append(msg)
        return out

    def _record_drop(self, kind: str, src: Endpoint, dst: Endpoint, seq: int,
                     mid: int, ts: float, cause: str) -> None:
        if self.recorder is not None:
            self.recorder.instant("ctrl/drop", self._track(src, dst), ts,
                                  attrs={"kind": kind, "src": str(src),
                                         "dst": str(dst), "seq": int(seq),
                                         "mid": mid, "cause": cause})

    # ------------------------------------------------------------- schedule

    def next_wake(self, now: float) -> List[float]:
        """Instants at which the fabric's state can change: pending
        delivery times (a message already DUE reports ``now`` — the next
        poll round will deliver it, so a stalled simulator must take a
        zero-width step, not jump past it) and partition window boundaries
        — the idle-jump input (a stalled fleet must wake when a partition
        heals, not spin or die)."""
        out = [max(ts, now) for ts, _, _ in self._in_flight]
        for p in self.partitions:
            for b in (p.t0, p.t1):
                if b > now:
                    out.append(b)
        return out

    @property
    def in_flight(self) -> int:
        return len(self._in_flight)

    def summary(self) -> dict:
        return {**self.stats, "in_flight": len(self._in_flight),
                "partitions": [p.name for p in self.partitions],
                "links": self.link_health(),
                "seed": self.seed}
