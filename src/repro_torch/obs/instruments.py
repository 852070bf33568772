"""Standard instrument bundles for the serving loop and query engine.

The stack's metric *names and labels* are the public interface
(OBSERVABILITY.md lists them all); this module pins them in one place so
``serve/server.py`` and ``engine/service.py`` stay free of exposition
details.  Each bundle registers its families on a registry once and
caches labeled children up front, so hot-path calls (``observe_flush``,
``observe_cache``) are attribute bumps with no dict construction.

The port's bundles carry every family of the reference's: the serving
families, and the engine's plan-cache, closure, delta (the count states'
repairs and drops among them), block-sparse and count-state families
(with ``delta_epoch_lag``, which the serving loop sets).

Bundles are memoized per registry (:meth:`ServeMetrics.on`): the server
and the engine can both ask for "the serve metrics of this registry" and
get the same families instead of a double-registration error.
"""
from __future__ import annotations

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    LATENCY_BUCKETS_S,
    MetricsRegistry,
    REGISTRY,
    SIZE_BUCKETS,
)

# iteration counts per closure call: warm restarts double capacity, so
# calls are short; the tail bucket catches pathological grammars
ITER_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


class _Bundle:
    """Per-registry memoized family bundle."""

    _slot: str = ""  # subclass-specific cache attribute on the registry

    @classmethod
    def on(cls, registry: MetricsRegistry | None = None):
        registry = REGISTRY if registry is None else registry
        cached = getattr(registry, cls._slot, None)
        if cached is None:
            cached = cls(registry)
            setattr(registry, cls._slot, cached)
        return cached


class ServeMetrics(_Bundle):
    """Serving-loop families: admission, coalescing, latency, routing."""

    _slot = "_repro_serve_bundle"

    def __init__(self, registry: MetricsRegistry) -> None:
        self.admitted = Counter(
            "serve_admitted_total", "Requests accepted at admission",
            registry=registry,
        )
        self.shed = Counter(
            "serve_shed_total", "Requests rejected by admission control",
            registry=registry,
        )
        self.outcomes = Counter(
            "serve_outcomes_total",
            "Resolved requests by outcome (served|failed|cancelled)",
            labelnames=("outcome",), registry=registry,
        )
        self.flushes = Counter(
            "serve_flushes_total",
            "Batch-window flushes by trigger reason",
            labelnames=("reason",), registry=registry,
        )
        self.coalesced = Counter(
            "serve_coalesced_total",
            "Requests that shared a batch with at least one other",
            registry=registry,
        )
        self.queue_depth = Gauge(
            "serve_queue_depth", "Requests admitted but not yet resolved",
            registry=registry,
        )
        self.queue_delay = Histogram(
            "serve_queue_delay_seconds",
            "Admission to batch-execution start",
            buckets=LATENCY_BUCKETS_S, registry=registry,
        )
        self.batch_exec = Histogram(
            "serve_batch_exec_seconds",
            "Engine execution time per flushed batch",
            buckets=LATENCY_BUCKETS_S, registry=registry,
        )
        self.batch_size = Histogram(
            "serve_batch_size", "Queries per flushed batch",
            buckets=SIZE_BUCKETS, registry=registry,
        )
        self.planner_route = Counter(
            "planner_route_total",
            "Batches executed per planner decision label",
            labelnames=("route",), registry=registry,
        )
        self.planner_fallback = Counter(
            "planner_fallback_total",
            "Batches that hit a mid-closure planner fallback",
            registry=registry,
        )
        # pre-create the closed label sets so scrapes show zeros rather
        # than absent series, and hot paths never take the creation lock
        self._outcome = {
            k: self.outcomes.labels(outcome=k)
            for k in ("served", "failed", "cancelled")
        }

    def observe_flush(self, reason: str, batch: int) -> None:
        self.flushes.labels(reason=reason).inc()
        self.batch_size.observe(batch)
        if batch > 1:
            self.coalesced.inc(batch)

    def observe_outcome(self, outcome: str, n: float = 1.0) -> None:
        self._outcome[outcome].inc(n)

    def observe_decision(self, route: str, fallback: bool) -> None:
        self.planner_route.labels(route=route).inc()
        if fallback:
            self.planner_fallback.inc()


class EngineMetrics(_Bundle):
    """Engine-side families: plan cache, closure calls, delta repair, the
    block-sparse state's occupancy and the count state's mask."""

    _slot = "_repro_engine_bundle"

    def __init__(self, registry: MetricsRegistry) -> None:
        self.cache_lookups = Counter(
            "plan_cache_lookups_total",
            "Compiled-closure cache lookups by result (hit|miss)",
            labelnames=("state",), registry=registry,
        )
        self.closure_calls = Counter(
            "closure_calls_total",
            "Compiled closure executions by engine backend",
            labelnames=("engine",), registry=registry,
        )
        self.closure_iters = Histogram(
            "closure_fixpoint_calls",
            "Warm-restart ladder length per fixpoint solve",
            buckets=ITER_BUCKETS, registry=registry,
        )
        self.delta_rows_repaired = Counter(
            "delta_rows_repaired_total",
            "Materialized rows repaired in place by delta ingest",
            registry=registry,
        )
        self.delta_rows_evicted = Counter(
            "delta_rows_evicted_total",
            "Materialized rows evicted (frozen-row overflow) by delta ingest",
            registry=registry,
        )
        self.delta_repair_iters = Counter(
            "delta_repair_iters_total",
            "Fixpoint iterations spent in delta repair closures",
            registry=registry,
        )
        self.delta_count_repairs = Counter(
            "delta_count_repairs_total",
            "Counting states repaired by insert-only recount",
            registry=registry,
        )
        self.delta_count_drops = Counter(
            "delta_count_drops_total",
            "Counting states dropped whole by a deletion delta",
            registry=registry,
        )
        self.count_active_rows = Gauge(
            "count_state_active_rows",
            "Materialized mask rows of the last count-served closure state",
            registry=registry,
        )
        self.delta_epoch = Gauge(
            "delta_epoch", "Current graph epoch of the engine",
            registry=registry,
        )
        self.delta_epoch_lag = Gauge(
            "delta_epoch_lag_seconds",
            "Wall time the most recent delta spent fenced before apply",
            registry=registry,
        )
        self.blocksparse_occupied_blocks = Gauge(
            "blocksparse_occupied_blocks",
            "Occupied bit-tiles of the last blocksparse-served closure "
            "state (materialized memory is proportional to this)",
            registry=registry,
        )
        self._hit = self.cache_lookups.labels(state="hit")
        self._miss = self.cache_lookups.labels(state="miss")

    def observe_cache(self, hit: bool) -> None:
        (self._hit if hit else self._miss).inc()

    def observe_closure(self, engine: str, calls: int) -> None:
        self.closure_calls.labels(engine=engine).inc(calls)
        self.closure_iters.observe(calls)

    def observe_delta(self, stats) -> None:
        """Fold one ``DeltaStats`` into the counters."""
        self.delta_rows_repaired.inc(stats.rows_repaired)
        self.delta_rows_evicted.inc(stats.rows_evicted)
        self.delta_repair_iters.inc(stats.repair_iters)
        self.delta_count_repairs.inc(stats.count_repairs)
        self.delta_count_drops.inc(stats.count_drops)

    def observe_count_state(self, active_rows: int) -> None:
        """Record the mask size of a just-served counting state."""
        self.count_active_rows.set(float(active_rows))

    def observe_blocksparse(self, occupied: int) -> None:
        """Record the occupied-block count of a blocksparse-served state."""
        self.blocksparse_occupied_blocks.set(float(occupied))
