"""Agentic session serving: multi-turn sessions over the fleet
(docs/SERVING.md "Agentic sessions").

The session layer the L7 serving stack exists for: validated
:class:`Session` state machines (ACTIVE_TURN → THINKING → … → CLOSED,
with mid-generation TOOL_STALL parks through the r22 host KV tier),
per-turn prefix growth (turn N+1's prompt = turn N's full transcript),
and the drivers that move sessions closed-loop through one
:class:`~..engine.ServingEngine` (:class:`SessionManager`) or a fleet
:class:`~..fleet.router.Router` (:class:`FleetSessionCoordinator`, the
``FleetSimulator`` controller).  The seeded workload generator is
:func:`~..fleet.sim.session_arrivals`; the fleet placement policy is
``session_affinity`` (fleet/policies.py).
"""

from .manager import FleetSessionCoordinator, SessionManager
from .session import Session, SessionConfig, SessionState, ToolCallDetector

__all__ = ["Session", "SessionConfig", "SessionState", "ToolCallDetector",
           "SessionManager", "FleetSessionCoordinator"]
