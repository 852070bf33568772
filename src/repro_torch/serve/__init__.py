"""Async serving loop with admission control — the port's copy of
``repro.serve``, over :mod:`repro_torch.engine`.

``CFPQServer`` fronts a :class:`~repro_torch.engine.QueryEngine` with an
asyncio admission queue, a per-(grammar, semantics, backend) batch-window
coalescer, bounded-depth load shedding (:class:`Overloaded`), and an
epoch-fenced writer path for ``apply_delta``.  Every flushed batch window
routes through the engine's cost-based planner (``repro_torch.engine.planner``)
— decisions and mid-closure fallbacks are tallied in
``ServeStats.planner_routes`` / ``.fallbacks``.  See SERVING.md.

The engine-side public surface (``QueryEngine``, ``EngineConfig``,
``Query``, ``QueryResult``) is re-exported here so serving callers import
one package.
"""
from repro_torch.engine import EngineConfig, Query, QueryEngine, QueryResult

from .coalesce import BatchWindow
from .config import FlushReason, Overloaded, ServeConfig, ServeStats
from .loadgen import OpenLoopRun, drive_open_loop, poisson_arrivals
from .server import CFPQServer

__all__ = [
    "BatchWindow",
    "CFPQServer",
    "EngineConfig",
    "FlushReason",
    "OpenLoopRun",
    "Overloaded",
    "Query",
    "QueryEngine",
    "QueryResult",
    "ServeConfig",
    "ServeStats",
    "drive_open_loop",
    "poisson_arrivals",
]
