"""Resilience: deterministic fault injection, crash-safe I/O, budgeted
retry, the step watchdog and the ``resilience/*`` event surface — the
port's own copies of the JAX package's ``resilience/{events,
fault_injection,atomic_io,retry,watchdog}.py`` (numpy and the stdlib
only), which the serving stack and the fleet use.

* :mod:`fault_injection` — seeded, config/env-driven faults at named
  sites (torn writes, transient OSErrors, device loss, stragglers).
* :mod:`atomic_io` — temp+fsync+rename publication and the crc32
  checkpoint manifest (the flight recorder's dumps go through it).
* :mod:`retry` — exponential backoff with deterministic jitter and a
  hard time budget.
* :mod:`watchdog` — hung-step timeout classified as device loss (the
  fleet's ``health.classify_fatal`` treats it as fatal).
* :mod:`events` — every fault/retry/fallback/recovery on the
  ``resilience/*`` monitor surface.
"""

from . import events
from .atomic_io import (MANIFEST_NAME, atomic_savez, atomic_write_bytes, atomic_write_json, atomic_write_text,
                        build_manifest, crc32_array, crc32_bytes, crc32_file, has_manifest, npz_array_crcs,
                        verify_manifest, write_manifest)
from .fault_injection import (ENV_PLAN_VAR, INJECTION_SITES, DeviceLossError, FaultInjector, FaultSpec,
                              InjectedCrash, InjectedTransientError, configure_fault_injection, fault_injector)
from .retry import RetryPolicy, backoff_until, retry_call
from .watchdog import StepHungError, StepWatchdog

__all__ = [
    "events",
    "MANIFEST_NAME", "atomic_savez", "atomic_write_bytes", "atomic_write_json",
    "atomic_write_text", "build_manifest", "crc32_array", "crc32_bytes",
    "crc32_file", "has_manifest", "npz_array_crcs", "verify_manifest",
    "write_manifest",
    "ENV_PLAN_VAR", "INJECTION_SITES", "DeviceLossError", "FaultInjector",
    "FaultSpec", "InjectedCrash", "InjectedTransientError",
    "configure_fault_injection", "fault_injector",
    "RetryPolicy", "backoff_until", "retry_call",
    "StepHungError", "StepWatchdog",
]
