"""Serving-loop knobs, typed admission errors, and server-level stats.

The three knobs trade latency against throughput (measured for the JAX
package in benchmarks/bench_serving.py; discussion in SERVING.md):

``max_batch``
    Flush a batch window as soon as this many compatible queries are
    buffered — the size bound of the coalescer.
``batch_window_s``
    Flush a non-full window this long after its first query arrived — the
    deadline bound.  Every admitted query therefore waits at most
    ``batch_window_s`` before its closure call starts (plus lock/queue
    time), which is what bounds p99 at low load.
``max_queue_depth``
    Admission control: the number of admitted-but-unresolved queries the
    server will hold.  Beyond it, ``submit`` sheds load by raising
    :class:`Overloaded` immediately instead of queueing unboundedly.
"""
from __future__ import annotations

from dataclasses import dataclass, field


class Overloaded(RuntimeError):
    """Load shed at admission: the bounded queue is full.

    Raised *synchronously* by ``CFPQServer.submit`` — the query was never
    admitted, holds no queue slot, and owns no future, so callers can
    retry with backoff without leaking server state.
    """

    def __init__(self, depth: int, limit: int) -> None:
        super().__init__(
            f"admission queue full ({depth} in flight >= limit {limit})"
        )
        self.depth = depth
        self.limit = limit


class FlushReason:
    """Why a batch window was flushed (surfaced in per-result stats)."""

    SIZE = "size"  # max_batch compatible queries buffered
    DEADLINE = "deadline"  # batch_window_s elapsed since the first query
    FENCE = "fence"  # a writer is about to commit a delta
    DRAIN = "drain"  # server drain/stop

    ALL = (SIZE, DEADLINE, FENCE, DRAIN)


@dataclass(frozen=True)
class ServeConfig:
    """Knobs of the async serving loop (see module docstring).

    ``metrics_port`` (with ``metrics_host``) additionally exposes the
    server's metrics registry over HTTP — ``GET /metrics`` is Prometheus
    text exposition, ``GET /metrics.json`` a JSON snapshot including
    live ``ServeStats`` (repro_torch.obs.export; OBSERVABILITY.md).  ``None``
    (the default) starts no listener; ``0`` binds an ephemeral port
    (read it back from ``CFPQServer.metrics_port`` after start).
    """

    max_batch: int = 8
    batch_window_s: float = 0.005
    max_queue_depth: int = 256
    metrics_host: str = "127.0.0.1"
    metrics_port: int | None = None

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.batch_window_s < 0:
            raise ValueError("batch_window_s must be >= 0")
        if self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        if self.metrics_port is not None and not (
            0 <= self.metrics_port <= 65535
        ):
            raise ValueError("metrics_port must be None or 0..65535")


@dataclass
class ServeStats:
    """Cumulative server counters (exposed as ``CFPQServer.stats``).

    ``admitted`` counts queries that passed admission, ``shed`` ones
    rejected with :class:`Overloaded`; every admitted query ends up in
    ``served``, ``failed``, or ``cancelled`` (its caller went away while
    it was parked in a window) — the exactly-once accounting the stress
    test asserts.  ``coalesced`` sums batch sizes, so
    ``coalesced / max(batches, 1)`` is the mean batch size actually
    achieved at the offered load.

    ``planner_routes`` tallies the planner decisions behind served
    batches (decision label → count, one per closure-call group that
    actually ran — cache-hit groups planned nothing); ``fallbacks``
    counts mid-closure re-dispatches.  Together they make the engine's
    routing visible at the serving layer without digging through
    per-result stats.
    """

    admitted: int = 0
    shed: int = 0
    served: int = 0
    failed: int = 0
    cancelled: int = 0
    writes: int = 0
    batches: int = 0
    coalesced: int = 0
    flushes: dict[str, int] = field(
        default_factory=lambda: {r: 0 for r in FlushReason.ALL}
    )
    planner_routes: dict[str, int] = field(default_factory=dict)
    fallbacks: int = 0

    def note_flush(self, reason: str, size: int) -> None:
        self.batches += 1
        self.coalesced += size
        self.flushes[reason] = self.flushes.get(reason, 0) + 1

    def note_decision(self, planner: dict | None, fallback: dict | None) -> None:
        """Tally one closure-call group's routing (from its result stats)."""
        if planner is not None:
            label = planner.get("label", "?")
            self.planner_routes[label] = self.planner_routes.get(label, 0) + 1
        if fallback is not None:
            self.fallbacks += 1

    @property
    def mean_batch(self) -> float:
        return self.coalesced / max(self.batches, 1)

    def as_dict(self) -> dict:
        return {
            "admitted": self.admitted,
            "shed": self.shed,
            "served": self.served,
            "failed": self.failed,
            "cancelled": self.cancelled,
            "writes": self.writes,
            "batches": self.batches,
            "coalesced": self.coalesced,
            "mean_batch": self.mean_batch,
            "flushes": dict(self.flushes),
            "planner_routes": dict(self.planner_routes),
            "fallbacks": self.fallbacks,
        }
