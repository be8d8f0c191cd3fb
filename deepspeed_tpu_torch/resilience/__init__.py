"""Resilience: deterministic fault injection, budgeted retry, and the
``resilience/*`` event surface — the port's own copies of the JAX
package's ``resilience/{events,fault_injection,retry}.py`` (stdlib only),
which the serving stack's fault sites use.

* :mod:`fault_injection` — seeded, config/env-driven faults at named
  sites (torn writes, transient OSErrors, device loss, stragglers).
* :mod:`retry` — exponential backoff with deterministic jitter and a
  hard time budget.
* :mod:`events` — every fault/retry/fallback/recovery on the
  ``resilience/*`` monitor surface.

``atomic_io`` and ``watchdog`` come with checkpoints (ROADMAP.md Queue 1).
"""

from . import events
from .fault_injection import (ENV_PLAN_VAR, INJECTION_SITES, DeviceLossError, FaultInjector, FaultSpec,
                              InjectedCrash, InjectedTransientError, configure_fault_injection, fault_injector)
from .retry import RetryPolicy, backoff_until, retry_call

__all__ = [
    "events",
    "ENV_PLAN_VAR", "INJECTION_SITES", "DeviceLossError", "FaultInjector",
    "FaultSpec", "InjectedCrash", "InjectedTransientError",
    "configure_fault_injection", "fault_injector",
    "RetryPolicy", "backoff_until", "retry_call",
]
