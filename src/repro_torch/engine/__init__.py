"""Batched single-/multi-source CFPQ query engine of the port.

``QueryEngine`` coalesces concurrent queries (relational, single-path,
conjunctive over a :class:`ConjunctiveGrammar`, count) over shared
grammars into one masked-closure call each and caches both closure plans
(plan.py) and materialized closure rows (service.py).  Construction takes
one typed :class:`EngineConfig` (``QueryEngine(graph, config=...)``); the
default ``engine="auto"`` routes every closure call through the cost-based
:class:`Planner` (planner.py), and per-request statistics are the typed
:class:`QueryStats` (stats.py).
"""
from repro_torch.core.conjunctive import ConjunctiveGrammar
from repro_torch.delta.repair import DeltaStats
from repro_torch.delta.txn import Snapshot, StaleSnapshotError

from .config import ENGINE_CHOICES, EngineConfig
from .plan import CompiledClosureCache, PlanKey, bucket_for, row_buckets
from .planner import (
    PlanDecision,
    PlanFeatures,
    Planner,
    PlannerProfile,
)
from .service import Query, QueryEngine, QueryResult, grammar_key
from .stats import QueryStats

__all__ = [
    "CompiledClosureCache",
    "ConjunctiveGrammar",
    "DeltaStats",
    "ENGINE_CHOICES",
    "EngineConfig",
    "PlanDecision",
    "PlanFeatures",
    "PlanKey",
    "Planner",
    "PlannerProfile",
    "Query",
    "QueryEngine",
    "QueryResult",
    "QueryStats",
    "Snapshot",
    "StaleSnapshotError",
    "bucket_for",
    "grammar_key",
    "row_buckets",
]
