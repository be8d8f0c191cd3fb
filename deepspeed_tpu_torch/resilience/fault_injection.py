"""Deterministic, seeded fault injection with NAMED sites.

The chaos contract this enables (docs/RESILIENCE.md): every I/O or
state-transition edge that can tear in production — checkpoint writes and
restores, host-tier ``host_opt_group*.npz`` save/load, NVMe swap I/O, the
engine's step dispatch, serving admission, fleet-router dispatch, KV
migration staging (export chunks and snapshot import) — is
wrapped in a named injection site.  A test (or an operator drill, via the environment) arms a
*plan* of :class:`FaultSpec` entries and the exact same code path that
runs in production fires torn writes, transient ``OSError``\\ s, device
losses, stragglers, or simulated process death at a deterministic,
reproducible point.

Determinism: count-triggered specs (``at``/``times``) fire on exact
per-site hit counts; probabilistic specs (``p``) draw from a
``random.Random(seed)`` owned by the injector, so the same plan + seed
produces the same fault sequence on every run and machine.

Fault taxonomy (what each ``kind`` models):

* ``os_error``    — transient I/O failure (EIO, NFS hiccup): raises
                    :class:`InjectedTransientError` (an ``OSError``), which
                    the retry layer is EXPECTED to absorb.
* ``crash``       — process death at this point: raises
                    :class:`InjectedCrash`, deliberately NOT an ``OSError``
                    so no retry/except-OSError path may swallow it.
* ``torn_write``  — process death mid-write: the atomic writer emits a
                    partial payload (``fraction`` of the bytes) to its temp
                    file, then raises :class:`InjectedCrash`.  The final
                    path is never updated — surviving old data intact is
                    the crash-safety property under test.
* ``corrupt``     — silent post-publish corruption (bit rot, a lying
                    fsync): the write completes, then a byte of the FINAL
                    file is flipped (or the file truncated to ``fraction``)
                    with no exception.  Checksum verification on load is
                    the detection property under test.  NOTE: only
                    meaningful at sites that run AFTER the tag manifest is
                    written (``ckpt.latest_publish``) — corruption armed at
                    a pre-manifest site is checksummed as-is by the later
                    ``write_manifest`` and self-masks (a truncated npz even
                    fails the save outright when the manifest reads it
                    back).  To model rot of manifest-covered files, mutate
                    them post-save, as the chaos tests do.
* ``device_loss`` — accelerator loss mid-step: raises
                    :class:`DeviceLossError` whose message carries a
                    ``DEVICE_LOST`` marker, so the elastic agent's
                    classification path (elasticity/elastic_agent.py)
                    triggers exactly as for a real device loss.
* ``latency``     — a straggler: sleeps ``delay_s`` (drives the step
                    watchdog without any real hang).

Arming: ``configure_fault_injection(plan, seed=...)`` with a dict
``{"seed": 0, "sites": [{"site": ..., "kind": ..., ...}]}`` (or a bare
list of site dicts, or a JSON string), or via the environment variable
``DSTPU_FAULT_PLAN`` (same JSON) — read once at import so launcher-spawned
processes inherit the drill.  ``configure_fault_injection(None)`` (with no
env plan) disarms.  Unarmed checks are a single ``is None`` test — the
hot step path pays nothing.
"""

import dataclasses
import json
import os
import time
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Union

from ..utils.logging import logger
from . import events

#: every named injection site; ``check``/``writer_fault`` reject unknown
#: names so a typo'd plan fails loudly instead of silently never firing.
INJECTION_SITES = frozenset({
    "ckpt.state_save",      # orbax state-tree save (checkpoint/engine.py)
    "ckpt.state_restore",   # orbax state-tree restore
    "ckpt.meta_write",      # meta.json atomic write
    "ckpt.manifest_write",  # crc32 manifest atomic write
    "ckpt.latest_publish",  # 'latest' tag-file atomic publish
    "host_opt.save",        # host-tier host_opt_group*.npz save (runtime/swap_tensor/host_streamed_optimizer.py)
    "host_opt.load",        # host-tier host_opt_group*.npz load
    "swap.write",           # NVMe/disk swap write issue (runtime/swap_tensor/swapper.py over ops/aio)
    "swap.read",            # NVMe/disk swap read issue
    "engine.step",          # training-step dispatch (runtime/engine.py)
    "engine.verify_step",   # speculative verify dispatch (inference/v2/engine_v2.py)
    "engine.aot_compile",   # AOT serving-step warm-up compile (inference/v2/engine_v2.py warm_all)
    "serving.admit",        # serving request admission (serving/engine.py)
    "admission.tenant",     # tenant-QoS admission bookkeeping (serving/fleet/router.py)
    "router.dispatch",      # fleet router request dispatch (serving/fleet/router.py)
    "autoscaler.decide",    # overload-control-plane decision probe (serving/fleet/autoscale.py)
    "kv.export",            # KV page d2h staging chunk (serving/kvtransfer/snapshot.py)
    "kv.import",            # KV snapshot h2d import (serving/kvtransfer/snapshot.py)
    "kv.demote",            # KV page demotion to the host tier (serving/kvtier/tier.py)
    "kv.promote",           # host-tier KV promotion back to device (serving/kvtier/tier.py)
    "prefix.publish",       # replica->directory digest publish/retract (serving/fleet/prefix_directory.py)
    "prefix.import",        # hot-prefix KV h2d adoption (serving/kvtransfer/snapshot.py)
    "transport.send",       # control-plane message send edge (serving/fleet/transport.py)
    "transport.deliver",    # control-plane message delivery edge (serving/fleet/transport.py)
    "lifecycle.cmd.send",   # router lifecycle-command send edge (serving/fleet/router.py)
    "lifecycle.cmd.apply",  # replica-side lifecycle-command apply edge (serving/fleet/router.py)
    "session.route",        # session-coordinator turn submit edge (serving/sessions/manager.py)
    "session.tool_result",  # tool-result delivery edge ending a stall (serving/sessions/manager.py)
})

_RAISING_KINDS = ("os_error", "crash", "device_loss", "latency")
_WRITER_KINDS = ("torn_write", "corrupt")
_KINDS = _RAISING_KINDS + _WRITER_KINDS


class InjectedCrash(Exception):
    """Simulated process death.  Deliberately NOT an OSError: nothing —
    retry loops included — may absorb it; the test harness catches it at
    the top and then 'resumes' with a fresh process/engine."""


class InjectedTransientError(OSError):
    """Transient injected I/O failure; the retry layer should absorb it."""


class DeviceLossError(RuntimeError):
    """Injected accelerator loss; message carries the DEVICE_LOST marker
    the elastic agent classifies on."""

    def __init__(self, site: str):
        super().__init__(f"DEVICE_LOST: injected device loss at site '{site}'")


@dataclasses.dataclass
class FaultSpec:
    """One planned fault.  Count-triggered by default: fires on per-site
    hit numbers ``at .. at+times-1`` (1-based).  Set ``p`` for seeded
    probabilistic firing instead (capped at ``times`` total fires)."""
    site: str
    kind: str
    at: int = 1
    times: int = 1
    p: Optional[float] = None
    delay_s: float = 0.05     # latency kind: straggler sleep seconds
    fraction: float = 0.5     # torn_write/corrupt: payload fraction kept
    truncate: bool = False    # corrupt: truncate instead of byte-flip

    def __post_init__(self):
        if self.site not in INJECTION_SITES:
            raise ValueError(f"unknown injection site '{self.site}'; "
                             f"registered sites: {sorted(INJECTION_SITES)}")
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind '{self.kind}'; one of {_KINDS}")


class FaultInjector:

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        import random
        self.specs = list(specs)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._hits: Counter = Counter()
        self._fired: Counter = Counter()  # per spec index

    # ----------------------------------------------------------- matching

    def _poll(self, site: str) -> Optional[FaultSpec]:
        """Count one hit of ``site``; return the spec that fires, if any."""
        if site not in INJECTION_SITES:
            raise ValueError(f"unknown injection site '{site}'")
        self._hits[site] += 1
        n = self._hits[site]
        for i, spec in enumerate(self.specs):
            if spec.site != site or self._fired[i] >= spec.times:
                continue
            if spec.p is not None:
                fires = self._rng.random() < spec.p
            else:
                fires = spec.at <= n < spec.at + spec.times
            if fires:
                self._fired[i] += 1
                events.emit("resilience/fault_injected", 1.0)
                logger.warning(f"FaultInjector: firing '{spec.kind}' at site "
                               f"'{site}' (hit {n})")
                return spec
        return None

    def apply(self, spec: FaultSpec) -> None:
        """Raise/sleep per a fired spec's kind (writer kinds are handled by
        the atomic writer that polled them)."""
        if spec.kind == "os_error":
            raise InjectedTransientError(f"injected transient I/O error at site '{spec.site}'")
        if spec.kind == "crash":
            raise InjectedCrash(f"injected crash (simulated process death) at site '{spec.site}'")
        if spec.kind == "device_loss":
            raise DeviceLossError(spec.site)
        if spec.kind == "latency":
            time.sleep(spec.delay_s)

    # ------------------------------------------------------------ surface

    def check(self, site: str) -> None:
        """Non-writer site probe: raises/sleeps when a raising-kind spec
        fires.  Writer kinds cannot be honored here and are skipped with a
        warning (arm them on a writer site instead)."""
        spec = self._poll(site)
        if spec is None:
            return
        if spec.kind in _WRITER_KINDS:
            logger.warning(f"FaultInjector: '{spec.kind}' armed on non-writer "
                           f"probe of '{site}' — ignored (use an atomic-writer site)")
            return
        self.apply(spec)

    def writer_fault(self, site: str) -> Optional[FaultSpec]:
        """Atomic-writer probe: raising kinds are applied immediately;
        torn_write/corrupt specs are RETURNED for the writer to enact
        against its payload/target."""
        spec = self._poll(site)
        if spec is None:
            return None
        if spec.kind in _RAISING_KINDS:
            self.apply(spec)
            return None
        return spec


_ACTIVE: Optional[FaultInjector] = None

#: env plan: same JSON as ``configure_fault_injection``'s dict form
ENV_PLAN_VAR = "DSTPU_FAULT_PLAN"


def configure_fault_injection(plan: Union[None, str, Dict, List] = None,
                              seed: int = 0) -> Optional[FaultInjector]:
    """Arm (or disarm) the process-wide injector.

    ``plan``: ``{"seed": int, "sites": [spec-dict, ...]}``, a bare list of
    spec dicts, a JSON string of either.  ``None``/empty ALWAYS disarms —
    even with ``DSTPU_FAULT_PLAN`` exported (the env plan is applied once
    at import via :func:`arm_from_env`; a test or drill that disarms must
    stay disarmed regardless of the ambient environment).
    """
    global _ACTIVE
    if isinstance(plan, str):
        plan = json.loads(plan)
    if not plan:
        _ACTIVE = None
        return None
    if isinstance(plan, dict):
        seed = int(plan.get("seed", seed))
        site_dicts = plan.get("sites", [])
    else:
        site_dicts = list(plan)
    specs = [d if isinstance(d, FaultSpec) else FaultSpec(**d) for d in site_dicts]
    _ACTIVE = FaultInjector(specs, seed=seed)
    logger.warning(f"fault injection ARMED: {len(specs)} spec(s), seed={seed}")
    return _ACTIVE


def fault_injector() -> Optional[FaultInjector]:
    return _ACTIVE


def check(site: str) -> None:
    """Module-level probe used by instrumented code; no-op (one ``is None``
    test) when injection is unarmed."""
    if _ACTIVE is not None:
        _ACTIVE.check(site)


def writer_fault(site: Optional[str]):
    if _ACTIVE is not None and site is not None:
        return _ACTIVE.writer_fault(site)
    return None


def arm_from_env() -> Optional[FaultInjector]:
    """Arm from ``DSTPU_FAULT_PLAN`` (no-op when unset).  Called once at
    import so launcher-spawned processes inherit a drill; NOT consulted by
    ``configure_fault_injection(None)`` — disarm means disarm."""
    env = os.environ.get(ENV_PLAN_VAR)
    if not env:
        return None
    return configure_fault_injection(env)


# launcher-spawned processes inherit a drill armed via the environment
try:
    arm_from_env()
except Exception as e:  # dslint-ok(crash-transparency): import-time arming only parses JSON config — no injectable code runs here; a malformed env plan must not break imports
    logger.warning(f"ignoring malformed {ENV_PLAN_VAR}: {e}")
