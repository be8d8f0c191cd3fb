"""Budgeted retry with exponential backoff + deterministic jitter.

Adopted by the checkpoint engine (meta/manifest/latest writes), the
swap-tensor disk I/O (swapper.py read/write issue) and serving admission
(serving/engine.py submit backoff).  Two properties matter here:

* **Determinism** — jitter draws from ``random.Random(seed ^ crc32(site))``,
  so a given (policy, site) pair produces the same delay sequence every
  run; chaos tests assert exact retry schedules.
* **Crash semantics** — only ``retry_on`` exception types are absorbed
  (default ``OSError``).  :class:`~.fault_injection.InjectedCrash` is
  deliberately not an ``OSError``: a simulated process death must
  propagate through every retry loop, or the chaos harness would be
  testing the retries instead of the recovery.

Every absorbed failure emits ``resilience/retry``; an exhausted budget
emits ``resilience/retry_exhausted`` and re-raises the last error.
"""

import dataclasses
import time
import zlib
from typing import Callable, Iterator, Optional, Tuple

from ..utils.logging import logger
from . import events


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 4          # total tries (1 initial + max_attempts-1 retries)
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5            # each delay scaled by 1 + jitter*U[-1,1]
    budget_s: float = 10.0         # hard cap on cumulative backoff sleep
    seed: int = 0
    retry_on: Tuple[type, ...] = (OSError, )

    def delays(self, site: str = "") -> Iterator[float]:
        """The deterministic backoff schedule for ``site`` (one delay per
        retry, already jittered and capped)."""
        import random
        rng = random.Random(self.seed ^ crc32_site(site))
        d = self.base_delay_s
        for _ in range(max(0, self.max_attempts - 1)):
            jittered = d * (1.0 + self.jitter * (2.0 * rng.random() - 1.0)) \
                if self.jitter else d
            yield max(0.0, min(jittered, self.max_delay_s))
            d *= self.multiplier


def crc32_site(site: str) -> int:
    return zlib.crc32(site.encode("utf-8")) & 0xFFFFFFFF


def retry_call(fn: Callable, policy: Optional[RetryPolicy] = None, site: str = "",
               sleep: Callable[[float], None] = time.sleep,
               on_retry: Optional[Callable[[int, BaseException, float], None]] = None):
    """Call ``fn()``; absorb ``policy.retry_on`` failures with backoff until
    the schedule or time budget runs out, then re-raise the last error."""
    policy = policy or RetryPolicy()
    schedule = list(policy.delays(site))
    spent = 0.0
    for attempt, delay in enumerate(schedule + [None], start=1):
        try:
            return fn()
        except policy.retry_on as e:
            if delay is None or spent + delay > policy.budget_s:
                events.emit("resilience/retry_exhausted")
                logger.warning(f"retry[{site or getattr(fn, '__name__', 'fn')}]: "
                               f"giving up after {attempt} attempt(s): {e}")
                raise
            events.emit("resilience/retry")
            logger.warning(f"retry[{site or getattr(fn, '__name__', 'fn')}]: "
                           f"attempt {attempt} failed ({e}); backing off {delay:.3f}s")
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
            spent += delay


def backoff_until(check: Callable[[], Tuple[bool, bool]], policy: RetryPolicy,
                  clock, site: str = "serving.admit",
                  event: str = "resilience/admission_retry") -> bool:
    """Clock-driven variant for admission-style gates: ``check()`` returns
    ``(ok, transient)``; backs off on ``clock`` (VirtualClock in tests,
    WallClock in production) while the failure stays transient and the
    budget lasts.  Returns the final ``ok``."""
    spent = 0.0
    ok = False
    for delay in policy.delays(site):
        if spent + delay > policy.budget_s:
            break
        events.emit(event)
        clock.wait_until(clock.now() + delay)
        spent += delay
        ok, transient = check()
        if ok or not transient:
            return ok
    return ok
