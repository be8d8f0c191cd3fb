"""``resilience/*`` monitor event surface.

Every injected fault, retry, checkpoint fallback, watchdog trip and
elastic recovery is emitted here as a ``(name, value, step)`` tuple — the
same shape the monitor layer's ``write_events`` consumes — so resilience
behaviour is observable on exactly the surface operators already watch
(TensorBoard/WandB/CSV, see monitor/monitor.py).

The bus is deliberately decoupled from the monitor: events are always
recorded into a bounded ring (tests assert on ``recent()``), and are
additionally forwarded to whatever monitor was last attached via
``attach_monitor`` (the engine attaches its MonitorMaster at build time).
Emission must never take down the operation being observed — forwarding
failures are swallowed with a warning.
"""

import itertools
import threading
from collections import deque
from typing import List, Optional, Tuple

from ..utils.logging import logger

_LOCK = threading.Lock()
_BUFFER: deque = deque(maxlen=2048)
_MONITOR = None
_COUNTER = itertools.count()


def attach_monitor(monitor) -> None:
    """Forward subsequent events to ``monitor.write_events`` (None detaches)."""
    global _MONITOR
    _MONITOR = monitor


def emit(name: str, value: float = 1.0, step: Optional[int] = None) -> None:
    assert name.startswith("resilience/"), f"resilience bus event without prefix: {name}"
    with _LOCK:
        if step is None:
            step = next(_COUNTER)
        event = (name, float(value), int(step))
        _BUFFER.append(event)
        monitor = _MONITOR
    if monitor is not None and getattr(monitor, "enabled", True):
        # deferred import: fault_injection imports this module at its top
        from .fault_injection import InjectedCrash
        try:
            monitor.write_events([event])
        except InjectedCrash:
            raise  # simulated process death must never be absorbed
        except Exception as e:  # observability must never break the operation
            logger.warning(f"resilience event forward failed: {e}")


def recent(prefix: Optional[str] = None) -> List[Tuple[str, float, int]]:
    with _LOCK:
        events = list(_BUFFER)
    if prefix is None:
        return events
    return [e for e in events if e[0].startswith(prefix)]


def clear() -> None:
    with _LOCK:
        _BUFFER.clear()
