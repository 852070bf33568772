"""Typed per-request statistics (the ``QueryResult.stats`` schema).

``QueryStats`` promotes the ad-hoc stats dict every layer was appending to
into a stable, typed schema: engine fields (cache state, chosen backend,
planner decision, fallback event, repair counters), batch fields, and the
serving-loop fields the async server stamps after batch execution.  The
mapping-style accessors (``stats["cache"]``) are kept so existing callers
and tests read it exactly as before; new code should use attributes.

``to_dict()`` is the JSON projection used by benchmarks — unset serving
fields are omitted so single-engine runs don't emit a page of nulls.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import ClassVar

#: serving-layer fields that are absent (None) unless the request went
#: through the async serving loop — omitted from ``to_dict`` when unset.
_SERVE_FIELDS = ("queue_delay_s", "batch_exec_s", "flush_reason", "window_batch")


@dataclass
class QueryStats:
    """Statistics of one served :class:`~repro_torch.engine.QueryResult`.

    Engine fields are filled by ``QueryEngine`` at batch-slice time;
    ``planner`` / ``fallback`` record the cost-based routing decision that
    picked the closure executable (``repro_torch.engine.planner``); the serving
    fields are stamped by ``CFPQServer`` after the batch executes.
    """

    # --- engine / closure ---
    latency_s: float = 0.0
    cache: str = ""  # hit | warm | miss
    engine: str = ""  # backend that served (planner-chosen or pinned)
    semantics: str = "relational"
    active_rows: int = 0
    epoch: int = 0
    # --- planner routing ---
    planner: dict | None = None  # PlanDecision.to_dict() of this group
    fallback: dict | None = None  # mid-closure re-dispatch event, if any
    # --- delta repair (cumulative over the engine's life) ---
    rows_repaired: int = 0
    rows_evicted: int = 0
    repair_iters: int = 0
    # --- compiled-plan cache ---
    compile_misses: int = 0
    compile_hits: int = 0
    # --- batching ---
    batched_with: int = 0  # queries in this (grammar, semantics) group
    batch_total: int = 0  # queries submitted together
    batch_groups: int = 0  # closure-call groups they were sliced into
    # --- serving loop (None unless served through CFPQServer) ---
    queue_delay_s: float | None = None
    batch_exec_s: float | None = None
    flush_reason: str | None = None
    window_batch: int | None = None
    #: escape hatch for layer-specific annotations (``stats_extra``)
    extra: dict = field(default_factory=dict)

    _FIELDS: ClassVar[frozenset] = frozenset()  # populated below

    # ------------------------------------------------------------------ #
    # mapping-style compatibility: stats["cache"], .get, .update, `in`
    # ------------------------------------------------------------------ #
    def __getitem__(self, key: str):
        if key in self._FIELDS:
            return getattr(self, key)
        return self.extra[key]

    def __setitem__(self, key: str, value) -> None:
        if key in self._FIELDS:
            setattr(self, key, value)
        else:
            self.extra[key] = value

    def __contains__(self, key: str) -> bool:
        if key in self._FIELDS:
            return getattr(self, key) is not None
        return key in self.extra

    def get(self, key: str, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def update(self, other: dict) -> None:
        for k, v in other.items():
            self[k] = v

    # ------------------------------------------------------------------ #
    def copy(self) -> "QueryStats":
        """Per-result copy (each request in a batch gets its own stats)."""
        return dataclasses.replace(
            self,
            extra=dict(self.extra),
            planner=dict(self.planner) if self.planner else self.planner,
            fallback=dict(self.fallback) if self.fallback else self.fallback,
        )

    def to_dict(self) -> dict:
        """JSON projection: every set field plus the extras, flat."""
        out = {}
        for f in self._FIELDS:
            if f == "extra":
                continue
            v = getattr(self, f)
            if f in _SERVE_FIELDS and v is None:
                continue
            out[f] = v
        out.update(self.extra)
        return out


QueryStats._FIELDS = frozenset(
    f.name for f in dataclasses.fields(QueryStats)
)
