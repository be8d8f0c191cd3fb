"""Step watchdog: hung-step timeout → device-loss classification.

A wedged collective (one rank dropped out mid-all-reduce, a hung copy)
does not raise — the step simply never completes.  The watchdog turns
that silence into the SAME failure class a dead device produces:
``run(fn)`` executes the step on a worker thread, and if it exceeds
``timeout_s`` raises :class:`StepHungError` whose message carries the
``DEVICE_LOST`` marker, so a recovery path keyed on device loss (the
fleet's ``health.classify_fatal``) fires exactly as for a lost device.
The port's copy of the JAX package's ``resilience/watchdog.py``.

Caveat (documented, inherent): Python threads cannot be killed, so the
abandoned worker may still be blocked inside the runtime when the agent
rebuilds the engine.  That matches the production story — recovery from a
hung step re-establishes the distributed runtime, invalidating whatever
the stuck call was waiting on — but it means ``timeout_s`` must be a
generous multiple of the worst-case step (compile steps included), not a
p99 latency.
"""

import threading
from typing import Callable, Optional

from ..utils.logging import logger
from . import events


class StepHungError(RuntimeError):
    """A watched step exceeded its deadline; classified as device loss."""

    def __init__(self, name: str, timeout_s: float):
        super().__init__(
            f"DEVICE_LOST: step '{name}' exceeded the {timeout_s:.1f}s watchdog "
            "timeout (hung step classified as device loss; worker thread abandoned)")


class StepWatchdog:

    def __init__(self, timeout_s: float, name: str = "train_batch"):
        assert timeout_s > 0, f"watchdog timeout must be positive, got {timeout_s}"
        self.timeout_s = float(timeout_s)
        self.name = name
        self.hangs = 0

    def run(self, fn: Callable, *args, **kwargs):
        """Run ``fn(*args, **kwargs)`` under the deadline: returns its
        result, re-raises its exception, or raises :class:`StepHungError`
        after ``timeout_s``."""
        box = {}

        def target():
            try:
                box["result"] = fn(*args, **kwargs)
            except BaseException as e:  # dslint-ok(crash-transparency): cross-thread trampoline — the box is re-raised verbatim on the caller thread below, InjectedCrash included
                box["error"] = e

        worker = threading.Thread(target=target, name=f"watchdog-{self.name}",
                                  daemon=True)
        worker.start()
        worker.join(self.timeout_s)
        if worker.is_alive():
            self.hangs += 1
            events.emit("resilience/watchdog_hang")
            logger.warning(f"StepWatchdog: '{self.name}' hung past "
                           f"{self.timeout_s:.1f}s (hang #{self.hangs})")
            raise StepHungError(self.name, self.timeout_s)
        if "error" in box:
            raise box["error"]
        return box.get("result")
