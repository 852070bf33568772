"""Delta subsystem of the port: delta-edge ingestion with row-level closure
repair (the reference's DELTA.md holds the design).

Layers:
  * mutation   — ``core/graph.py``: ``insert_edges`` / ``delete_edges``
    append to an edge log under a monotone version counter;
  * repair     — ``repair.py`` (+ the reverse-reachability sweep and the
    repair closures in ``core/closure.py`` and ``core/semantics.py``):
    turns a version range into row-level surgery on a materialized
    masked-closure state, Boolean or single-path length state;
  * serving    — ``txn.py`` + ``engine/service.py``: ``apply_delta`` on the
    query engine, epoch-tagged snapshots, repair stats in query results.
"""
from .repair import (
    DeltaStats,
    RepairPlan,
    plan_repair,
    repair_single_path_state,
    repair_state,
    reverse_reach_rows,
)
from .txn import EpochClock, Snapshot, StaleSnapshotError

__all__ = [
    "DeltaStats",
    "EpochClock",
    "RepairPlan",
    "Snapshot",
    "StaleSnapshotError",
    "plan_repair",
    "repair_single_path_state",
    "repair_state",
    "reverse_reach_rows",
]
